"""EER / min-tDCF of a CM score file.

    python -m asvspoof2021_air_tpu_torch.cli.evaluate_tdcf <cm_score_file> \\
        [--path_to_database DB | --asv_score_file FILE]

The port's own copy of the JAX package's ``cli/evaluate_tdcf.py``; it
prints ``{"eer": ..., "min_tdcf": ...}`` as a Python dict. ``--plot``
comes with the visualize module (ROADMAP Queue A, the tooling item).
"""

from __future__ import annotations

import argparse

from asvspoof2021_air_tpu_torch.metrics.evaluate import compute_eer_and_tdcf


def main(argv=None):
    p = argparse.ArgumentParser("EER and min-tDCF of a CM score file")
    p.add_argument("cm_score_file", type=str)
    p.add_argument("--path_to_database", type=str, default=None)
    p.add_argument("--asv_score_file", type=str, default=None)
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    eer, min_tdcf = compute_eer_and_tdcf(
        args.cm_score_file, args.path_to_database, args.asv_score_file,
        plot=args.plot)
    print({"eer": eer, "min_tdcf": min_tdcf})


if __name__ == "__main__":
    main()
