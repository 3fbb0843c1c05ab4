"""Tandem detection cost function (t-DCF) for CM+ASV cascades.

The port's own copy of the JAX package's ``metrics/tdcf.py``: the
ASVspoof 2019 normalized t-DCF curve. For every countermeasure threshold,
cost = C1 * Pmiss_cm + C2 * Pfa_cm, normalized by min(C1, C2); the minimum
over thresholds is the challenge's min-tDCF.
"""

from __future__ import annotations

import numpy as np

from asvspoof2021_air_tpu_torch.metrics.eer import compute_det_curve

# ASVspoof 2019 evaluation-plan cost model.
_PSPOOF = 0.05
ASVSPOOF2019_COST_MODEL = {
    "Pspoof": _PSPOOF,
    "Ptar": (1 - _PSPOOF) * 0.99,
    "Pnon": (1 - _PSPOOF) * 0.01,
    "Cmiss_asv": 1,
    "Cfa_asv": 10,
    "Cmiss_cm": 1,
    "Cfa_cm": 10,
}


def obtain_asv_error_rates(tar_asv, non_asv, spoof_asv, asv_threshold):
    """ASV operating-point error rates at a fixed threshold.

    Returns (Pfa_asv, Pmiss_asv, Pmiss_spoof_asv); the last is None when no
    spoof trials were scored against the ASV system.
    """
    tar_asv = np.asarray(tar_asv, dtype=np.float64)
    non_asv = np.asarray(non_asv, dtype=np.float64)
    spoof_asv = np.asarray(spoof_asv, dtype=np.float64)

    pfa_asv = float(np.sum(non_asv >= asv_threshold) / non_asv.size)
    pmiss_asv = float(np.sum(tar_asv < asv_threshold) / tar_asv.size)
    pmiss_spoof_asv = (
        None
        if spoof_asv.size == 0
        else float(np.sum(spoof_asv < asv_threshold) / spoof_asv.size)
    )
    return pfa_asv, pmiss_asv, pmiss_spoof_asv


def compute_tDCF(
    bonafide_score_cm,
    spoof_score_cm,
    Pfa_asv,
    Pmiss_asv,
    Pmiss_spoof_asv,
    cost_model=None,
    print_cost=False,
):
    """Normalized t-DCF curve over all CM thresholds.

    Returns ``(tDCF_norm, CM_thresholds)``; ``min(tDCF_norm)`` is the
    challenge min-tDCF. The sanity checks are the reference's.
    """
    cost_model = dict(ASVSPOOF2019_COST_MODEL if cost_model is None else cost_model)

    if any(cost_model[k] < 0 for k in ("Cfa_asv", "Cmiss_asv", "Cfa_cm", "Cmiss_cm")):
        raise ValueError("cost values must be non-negative")
    priors = (cost_model["Ptar"], cost_model["Pnon"], cost_model["Pspoof"])
    if any(p < 0 for p in priors) or abs(sum(priors) - 1) > 1e-10:
        raise ValueError("prior probabilities must be positive and sum to one")
    if Pmiss_spoof_asv is None:
        raise ValueError("need the ASV miss rate on spoof trials")

    combined = np.concatenate(
        (np.asarray(bonafide_score_cm, dtype=np.float64),
         np.asarray(spoof_score_cm, dtype=np.float64))
    )
    if np.isnan(combined).any() or np.isinf(combined).any():
        raise ValueError("CM scores contain nan or inf")
    if np.unique(combined).size < 3:
        raise ValueError("provide soft CM scores, not binary decisions")

    pmiss_cm, pfa_cm, cm_thresholds = compute_det_curve(
        bonafide_score_cm, spoof_score_cm
    )

    c1 = (
        cost_model["Ptar"]
        * (cost_model["Cmiss_cm"] - cost_model["Cmiss_asv"] * Pmiss_asv)
        - cost_model["Pnon"] * cost_model["Cfa_asv"] * Pfa_asv
    )
    c2 = cost_model["Cfa_cm"] * cost_model["Pspoof"] * (1 - Pmiss_spoof_asv)
    if c1 < 0 or c2 < 0:
        raise ValueError(
            "negative t-DCF weights; check the ASV error rates"
        )

    tdcf = c1 * pmiss_cm + c2 * pfa_cm
    tdcf_norm = tdcf / min(c1, c2)

    if print_cost:
        print(
            "t-DCF evaluation from [Nbona={}, Nspoof={}] trials\n".format(
                np.asarray(bonafide_score_cm).size, np.asarray(spoof_score_cm).size
            )
        )
        if c2 <= c1:
            print(
                "   tDCF_norm(s) = {:8.5f} x Pmiss_cm(s) + Pfa_cm(s)\n".format(c1 / c2)
            )
        else:
            print(
                "   tDCF_norm(s) = Pmiss_cm(s) + {:8.5f} x Pfa_cm(s)\n".format(c2 / c1)
            )

    return tdcf_norm, cm_thresholds
