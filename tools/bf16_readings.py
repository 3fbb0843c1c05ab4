#!/usr/bin/env python3
"""The readings behind ``check_bf16_ecapa`` (``tests/test_torch_train_bf16.py``,
also called by ``tests/test_torch_unfused.py``): for every quantity its
rule holds (embeddings, logits, BN statistics, gradients), the distance
from the port's bf16 value to JAX's bf16 one (jb) and to JAX's f32 one
(j32), ``own``, JAX's bf16 distance from its f32, and the check's bar,
max(2 own, 1e-2). The check itself asserts and prints nothing.

As a pytest plugin it records them, one JSON line for each call of the
check, without touching the test:

    PYTHONPATH=tools READINGS_OUT=readings.jsonl JAX_PLATFORMS=cpu \\
        python -m pytest -p bf16_readings tests/test_torch_train_bf16.py \\
        tests/test_torch_unfused.py -k bf16_ecapa

Run as a script it prints, for each recorded call, the largest share of
its bar that a quantity uses (the check fails above 1: for outputs and
statistics jb / bar, for a gradient min(jb, j32) / bar), the shares of
``layer1.convs.1.bias``, of the worst other gradient and of the worst
output or statistic, and the least j32 / own of the outputs and of the
statistics (the check fails below 0.25):

    python3 tools/bf16_readings.py readings.jsonl
"""

import json
import os
import sys

WATCHED = "layer1.convs.1.bias"
OUTPUTS = ("embedding", "logits")


def _record(frame, event, arg):
    if event != "return" or frame.f_code.co_name != "check_bf16_ecapa":
        return
    f = frame.f_locals
    if "readings" not in f:
        return                      # the check raised before its readings
    with open(os.environ["READINGS_OUT"], "a") as out:
        out.write(json.dumps({
            "test": os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0],
            "train": f["train"], "fused": f["fused"],
            "rows": f["readings"]}) + "\n")


def pytest_runtest_setup(item):
    if "bf16_ecapa" in item.name:
        sys.setprofile(_record)


def pytest_runtest_teardown(item):
    sys.setprofile(None)


def _is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def main() -> int:
    for line in open(sys.argv[1]):
        r = json.loads(line)
        rows = r["rows"]
        values = [k for k in rows if k in OUTPUTS or _is_stat(k)]
        grads = [k for k in rows if k not in values]
        share = {k: rows[k][0] / rows[k][3] for k in values}
        share.update({k: min(rows[k][:2]) / rows[k][3] for k in grads})
        named = [k for k in [WATCHED] if k in share] + [
            max(ks, key=share.get)
            for ks in ([k for k in grads if k != WATCHED], values) if ks]
        cells = [f"max share {max(share.values()):.3f}: " + ", ".join(
            f"{k} {share[k]:.3f}" for k in named)]
        for what, keys in (("outputs", [k for k in values if k in OUTPUTS]),
                           ("statistics", [k for k in values
                                           if _is_stat(k)])):
            off = {k: rows[k][1] / rows[k][2] for k in keys if rows[k][2]}
            if off:
                k = min(off, key=off.get)
                cells.append(f"j32/own {what} {k} {off[k]:.3f}")
        print(f"{r['test']} train={r['train']} fused={r['fused']} | "
              + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
