"""Readings that set a cell's limits: the compared numbers of sound runs of
the program over many seeds (the lower reading), of the control (the
upper reading) and, for a training cell, of its faults.

    python portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--seconds 2]

One process reads every seed: each seed builds the program anew from its
weights and inputs, runs it as a benchmark run does (a scoring cell for a
short window, a training cell through its set-up, which ends on the
replays that are compared), frees it, and compares it with the plain
reference. On the control seeds it also reads:

- a scoring cell: the reference with float8 products in the program's
  place;
- a training cell: the reference with float8 products in the program's
  place; the faults "half of each batch left out" (the reference on the
  first half of each batch's rows, its mean taken over them) and "the
  learning rate doubled" (the reference so); and, as a witness, the
  reference with bfloat16 products.

A state left unchanged reads 1 on ``change_gap`` and
``moment_gap_median`` by their definition and needs no run. The
benchmark's own runs do not run this. Each reading is a JSON line on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.run import cache_dirs  # noqa: E402


def score_readings(task, control: bool) -> dict:
    ref = task.reference_scores()
    out = {"program": task.numbers(reference=ref)}
    if control:
        low = task.reference_scores(prec="fp8")
        out["control"] = task.numbers(answers=list(enumerate(low)),
                                      reference=ref)
        out["control_kind"] = "reference with float8 e4m3 products"
    return out


def train_readings(task, control: bool) -> dict:
    from portbench.tasks.train_feat import compare

    ref = task.reference()
    out = {"program": compare(task.first, ref, task.params0, detail=True)}
    if control:
        out["witness_bf16"] = compare(task.reference(prec="bf16"), ref,
                                      task.params0, detail=True)
        out["control"] = compare(task.reference(prec="fp8"), ref,
                                 task.params0, detail=True)
        out["control_kind"] = "reference with float8 e4m3 products"
        half = slice(0, task.batch // 2)
        out["half_batch"] = compare(task.reference(rows=half), ref,
                                    task.params0)
        out["double_rate"] = compare(task.reference(rate=2.0), ref,
                                     task.params0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="{}",
                    help="JSON of configuration keys to change, for a "
                         "witness (such as the program in float32)")
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from portbench.harness import bench, inputs

    cell = bench.Cell(args.workload,
                      overrides={"config": json.loads(args.config)})
    dev = torch.device(args.device)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        t0 = time.perf_counter()
        weights = inputs.make_weights(
            cell.config_module.param_spec(cell.config), seed, dev)
        task = cell.task.Task(cell, seed, dev, weights)
        task.setup()
        if cell.task.UNIT == "batch":
            task.run(seconds=args.seconds)
        task.release()
        control = seed in args.control_seeds
        if cell.task.UNIT == "batch":
            got = score_readings(task, control)
        else:
            got = train_readings(task, control)
        got.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(got), flush=True)
        del task, weights
    return 0


if __name__ == "__main__":
    sys.exit(main())
