"""The harness is driven by data: a cell, a configuration, a traffic mix, a
metric and limits that exist only as new files run without an edit to a
file that is there. The trace reading on a made-up profile."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench.harness import bench, readers, trace

REPO = bench.ROOT


def test_a_cell_defined_only_in_new_files_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "portbench"
    cfg = json.loads((here / "configs" / "ecapa_tdnn_512.json").read_text())
    cfg.update(name="ecapa_tiny", channels=32, feat_len=40,
               compute_dtype="float32")
    (here / "configs" / "ecapa_tiny.json").write_text(json.dumps(cfg))
    shutil.copy(here / "configs" / "ecapa_tdnn_512.py",
                here / "configs" / "ecapa_tiny.py")
    traffic = json.loads((here / "traffic" / "wave-score.json").read_text())
    traffic.update(batch=3, pool_batches=2, max_samples=39 * 160)
    (here / "traffic" / "wave-tiny.json").write_text(json.dumps(traffic))
    (here / "metrics" / "batches_traced.py").write_text(
        "def read(ctx):\n    return ctx.slice.units\n")
    (here / "limits" / "tiny-cell.json").write_text(json.dumps(
        {"score_gap": {"limit": 1e-3}}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ecapa_tiny", "source": "test",
                            "file": "portbench/configs/ecapa_tiny.json",
                            "reduced": ["channels"], "why": "test"})
    spec["workloads"].append({"name": "tiny-cell", "config": "ecapa_tiny",
                              "traffic": "wave-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "score_utt_per_s" == m["name"]:
            m["workloads"].append("tiny-cell")
    spec["per_layer"].append({"name": "batches_traced", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "score_utt_per_s",
                              "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
            "from portbench import run;"
            "from portbench.harness import bench;"
            "c = bench.Cell('tiny-cell');"
            "print(json.dumps({'per_layer': [m['name'] for m in c.per_layer()],"
            " 'read': c.reader('batches_traced').read("
            "type('C', (), {'slice': type('S', (), {'units': 7})})),"
            " 'run': run.measure('tiny-cell', 2**31 + 5, 0.3, False,"
            " device='cpu')}))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, str(root)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["per_layer"] == ["batches_traced"]
    assert got["read"] == 7
    run = got["run"]
    assert set(run["metrics"]) == {"score_utt_per_s", "setup_s"}
    assert run["checks"]["score_gap"]["limit"] == 1e-3
    assert run["correct"] is True, run["checks"]
    assert list(run)[-1] == "checks"


class _Ev:
    def __init__(self, name, a, b, device):
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def test_slice_reading_on_a_made_up_profile():
    events = [_Ev("void lfcc_kernel<...>", 0, 10, True),
              _Ev("Memcpy HtoD (Pinned -> Device)", 10, 15, True),
              _Ev("ampere_bf16_s16816gemm_relu", 20, 50, True),
              _Ev("vectorized_elementwise_kernel", 45, 60, True),
              _Ev("Optimizer.step#Adam.step", 0, 100, True),
              _Ev("aten::copy_", 14, 30, False),
              _Ev("cudaStreamSynchronize", 15, 25, False)]
    prof = types.SimpleNamespace(events=lambda: events)
    sl = trace.Slice(prof, window_ms=0.1, units=2)
    assert sl.busy_us == 10 + 5 + 40
    assert sl.window_us == 100
    assert sl.idle_pct() == pytest.approx(45.0)
    assert sl.group_us() == {"B1": 10, "copy": 5, "matmul": 30,
                             "elementwise": 15}
    ctx = types.SimpleNamespace(slice=sl, work={"B1": {
        "flops": 0, "bytes": 3.35e12 * 2e-6, "peak": "tf32"}})
    # least 2 us a unit over 10 us / 2 units
    assert readers.roofline_pct(ctx, ["B1"]) == pytest.approx(40.0)
    assert readers.roofline_pct(ctx, ["B3"]) is None
    assert readers.group_ms(ctx, ("conv", "matmul")) == pytest.approx(0.015)
    assert readers.group_ms(ctx, ("optimizer",)) is None
    gaps = sl.breakdown()["idle_gaps"]
    assert gaps == [["cudaStreamSynchronize", 5e-6]]
