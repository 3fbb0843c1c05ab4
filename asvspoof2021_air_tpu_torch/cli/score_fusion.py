"""Score fusion of several systems' score files: average or
entropy-weighted, printing the fused polarity-min EER.

    python -m asvspoof2021_air_tpu_torch.cli.score_fusion -i f1 f2 ... \\
        -m {avg,wght} [-o ./fuse_scores/]

The port's own copy of the JAX package's ``cli/score_fusion.py``; both
methods write ``<output>/avg_fuse_score``, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

from asvspoof2021_air_tpu_torch.fusion import (
    avg_fuse, fused_eer, weighted_fuse)


def main(argv=None):
    p = argparse.ArgumentParser("Result Fusion Utility")
    p.add_argument("-i", "--input", type=str, nargs="+", required=True)
    p.add_argument("-o", "--output", type=str, default="./fuse_scores/")
    p.add_argument("-m", "--method", type=str, required=True,
                   choices=["avg", "wght"])
    args = p.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    out_file = os.path.join(args.output, "avg_fuse_score")
    if args.method == "avg":
        result = avg_fuse(args.input, out_file)
    else:
        result = weighted_fuse(args.input, output=out_file)
    print(fused_eer(result))


if __name__ == "__main__":
    main()
