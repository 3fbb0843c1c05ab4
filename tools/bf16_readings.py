#!/usr/bin/env python3
"""The readings behind ``check_bf16_ecapa`` (``tests/test_torch_train_bf16.py``,
also called by ``tests/test_torch_unfused.py``): for every gradient it
holds, the distance from the port's bf16 gradient to JAX's bf16 one and to
JAX's f32 one, and its bar. The check itself asserts and prints nothing.

As a pytest plugin it records them, one JSON line for each call of the
check, without touching the test:

    PYTHONPATH=tools READINGS_OUT=readings.jsonl JAX_PLATFORMS=cpu \\
        python -m pytest -p bf16_readings tests/test_torch_train_bf16.py \\
        tests/test_torch_unfused.py -k bf16_ecapa_matches_jax

Run as a script it prints, for each recorded call, ``layer1.convs.1.bias``
and the worst other gradient (noise parameters aside), each as
distances to JAX bf16 (jb) and to JAX f32 (j32), its bar, and
min(jb, j32) / bar, the share of the bar it uses (the check fails above
1):

    python3 tools/bf16_readings.py readings.jsonl
"""

import json
import os
import sys

import numpy as np

WATCHED = "layer1.convs.1.bias"


def _rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _record(frame, event, arg):
    if event != "return" or frame.f_code.co_name != "check_bf16_ecapa":
        return
    f = frame.f_locals
    if "gb" not in f or "port" not in f:
        return                      # the check raised before its gradients
    rows = {}
    for n, p in f["port"].named_parameters():
        if p.grad is None or not np.abs(f["gb"][n].numpy()).any():
            continue
        bar = max(_rel(f["gb"][n], f["g32"][n]), 1e-2)
        rows[n] = [_rel(p.grad, f["gb"][n]), _rel(p.grad, f["g32"][n]), bar]
    with open(os.environ["READINGS_OUT"], "a") as out:
        out.write(json.dumps({
            "test": os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0],
            "train": f["train"], "fused": f["fused"],
            "noise": list(f["noise"]), "rows": rows}) + "\n")


def pytest_runtest_setup(item):
    if "bf16_ecapa_matches_jax" in item.name:
        sys.setprofile(_record)


def pytest_runtest_teardown(item):
    sys.setprofile(None)


def main() -> int:
    for line in open(sys.argv[1]):
        r = json.loads(line)
        rows = {k: v for k, v in r["rows"].items() if k not in r["noise"]}
        share = {k: min(v[0], v[1]) / v[2] for k, v in rows.items()}
        worst = max((k for k in share if k != WATCHED), key=share.get)
        cells = []
        for k in (WATCHED, worst):
            jb, j32, bar = rows[k]
            cells.append(f"{k}: jb {jb:.4e} j32 {j32:.4e} bar {bar:.4e} "
                         f"({share[k]:.3f})")
        print(f"{r['test']} train={r['train']} fused={r['fused']} | "
              + " | worst other ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
