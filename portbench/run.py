"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. The cell's configuration, traffic mix, task, per-layer metrics and
limits are the files that ``BENCHMARK.json`` names (``harness/bench.py``).
Set-up makes the weights and inputs from ``--seed`` on the card, builds
the program's entry and warms up its one shape; the window then runs for
``--seconds``. With ``--trace 1`` a profiled slice of a few calls follows
the window and the per-layer metrics are reported instead of the
end-to-end ones. After the window the program is freed and the plain
reference decides ``correct``. The last line of standard output is the
result; the last lines of standard error are the compared numbers beside
their limits. Without the cards, or with the JAX package or its
libraries loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port builds its kernels into its own ``build/`` there, and any
    torch extension or Triton cache goes beside them."""
    build = ROOT / "asvspoof2021_air_tpu_torch" / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def traced_slice(task, units: int):
    """Profile ``units`` calls of the task's loop: its device events and
    host operations, with the slice's window timed by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import trace

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        done = task.run(count=units)
        stop.record()
        torch.cuda.synchronize()
    return trace.Slice(prof, start.elapsed_time(stop), done["units"])


def measure(workload: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", overrides=None,
            t_start: float = T_START) -> dict:
    """One run of ``workload``: the result line as a dict."""
    import torch

    from portbench.harness import bench, inputs, kernels

    t_cell = time.perf_counter()
    cell = bench.Cell(workload, overrides=overrides)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    weights = inputs.make_weights(
        cell.config_module.param_spec(cell.config), seed, dev)
    t_weights = time.perf_counter()
    task = cell.task.Task(cell, seed, dev, weights)
    task.setup()
    window = task.run(seconds=seconds)
    print(f"setup: {t_cell - t_start:.3f} s to the cell, "
          f"{t_weights - t_cell:.3f} s the device and weights, "
          f"{window['t0'] - t_weights:.3f} s the program's set-up",
          file=sys.stderr)
    print(f"window: {window['units']} {cell.task.UNIT}s in "
          f"{window['seconds']:.3f} s"
          + (f", {1e3 * window['waited_s'] / window['units']:.3f} ms a "
             f"batch waiting for the device" if "waited_s" in window
             else ""), file=sys.stderr)
    values = task.end_to_end(window)
    values["setup_s"] = window["t0"] - t_start
    metrics, extra = {}, {}
    if traced:
        sl = traced_slice(task, cell.traffic["traced_calls"])
        ctx = types.SimpleNamespace(
            slice=sl, window=window, flops=task.model_flops(window),
            work=task.kernel_work(),
            peak=kernels.PEAK_FLOPS[{"bfloat16": "bf16", "float32": "tf32"}[
                cell.config["compute_dtype"]]])
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = sl.breakdown()
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell.workload["chips"] if cuda else 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if cuda else 0}
    if traced:
        info["busy_s"] = sl.busy_us / 1e6
        info["window_s"] = sl.window_us / 1e6
    failed = task.failed()
    task.release()
    t_ref = time.perf_counter()
    verdict = bench.judge(task.numbers(), cell.limits)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    result = {"correct": bool(verdict["ok"] and failed == 0),
              "attempted": window["utterances"], "failed": failed,
              "metrics": metrics, "device": info}
    result.update(extra)
    result["checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from portbench.harness import bench

    chips = bench.by_name(bench.benchmark()["workloads"], args.workload,
                          "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = bench.forbidden_loaded()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
