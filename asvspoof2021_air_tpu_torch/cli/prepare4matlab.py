"""Split a keyed score file into ``_tar.txt`` / ``_non.txt`` score lists
for the official Matlab t-DCF tooling.

    python -m asvspoof2021_air_tpu_torch.cli.prepare4matlab <score_file>

The port's own copy of the JAX package's ``cli/prepare4matlab.py``.
"""

from __future__ import annotations

import argparse

from asvspoof2021_air_tpu_torch.metrics.evaluate import read_score_file


def convert2txt(score_file: str) -> tuple:
    cols = read_score_file(score_file)
    if cols["key"] is None:
        raise ValueError("score file needs bonafide/spoof keys")
    base = score_file[:-4] if score_file.endswith(".txt") else score_file
    tar_path, non_path = base + "_tar.txt", base + "_non.txt"
    with open(tar_path, "w") as tar, open(non_path, "w") as non:
        for key, score in zip(cols["key"], cols["score"]):
            (tar if key == "bonafide" else non).write(f"{score}\n")
    return tar_path, non_path


def main(argv=None):
    p = argparse.ArgumentParser("score file -> matlab tar/non lists")
    p.add_argument("score_file", type=str)
    args = p.parse_args(argv)
    tar, non = convert2txt(args.score_file)
    print(f"wrote {tar} and {non}")


if __name__ == "__main__":
    main()
