"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files that it names by name under ``portbench/``:

- ``configs/<config>.json`` (the configuration as run) and
  ``configs/<config>.py`` (its weights' names, FLOP count and kernels);
- ``traffic/<traffic>.json``, whose ``task`` names the loop in
  ``tasks/<task>.py``;
- ``metrics/<metric>.py``, one reader a per-layer metric;
- ``limits/<workload>.json``, the limits of the numbers that decide
  ``correct`` in a cell.

A later cell, configuration, traffic mix or metric is a set of new files
and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
# The JAX package and its libraries: none may be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "asvspoof2021_air_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_file(path: Path, label: str):
    """The module at ``path``, under a name made from ``label``."""
    name = "portbench_" + re.sub(r"\W", "_", label)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, overrides: Optional[dict] = None):
        """``overrides``: {"config" or "traffic": {key: value}}, keys of the
        cell's configuration or traffic mix changed (a test's small sizes, a
        witness's precision)."""
        self.bench = benchmark()
        self.workload = by_name(self.bench["workloads"], name, "workload")
        self.name = name
        entry = by_name(self.bench["configs"], self.workload["config"],
                        "config")
        self.config = read_json(ROOT / entry["file"])
        self.config_module = load_file(
            HERE / "configs" / f"{entry['name']}.py", "config_" + entry["name"])
        self.traffic = read_json(HERE / "traffic" /
                                 f"{self.workload['traffic']}.json")
        for key, vals in (overrides or {}).items():
            getattr(self, key).update(vals)
        self.task = importlib.import_module(
            f"portbench.tasks.{self.traffic['task']}")
        path = HERE / "limits" / f"{name}.json"
        self.limits: Dict[str, dict] = read_json(path) if path.exists() \
            else {}

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        moves = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str):
        return load_file(HERE / "metrics" / f"{metric}.py", "metric_" + metric)


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """The numbers that ``limits`` lists, each beside its limit; ``ok`` is
    False when a number with a limit is over it, missing or not finite,
    and when the cell has no limits at all. A number listed with the limit
    null is shown and not judged."""
    checks, ok = {}, any(v.get("limit") is not None for v in limits.values())
    for name, entry in limits.items():
        lim = entry.get("limit")
        value = numbers.get(name, float("nan"))
        ok &= math.isfinite(value) and (lim is None or value <= lim)
        checks[name] = {"value": value, "limit": lim}
    return {"ok": ok, "checks": checks}
