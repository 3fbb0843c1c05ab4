"""The readers of the program's spans and counters (``harness/spans.py``).

On the CPU: a made-up slice and node table, with the wrapper's feed copies
between the replays, a node libcuda named not, and a name that does not
match; a made-up scoring slice of host spans over device events.

Marked ``chip``: both training cells' traced slices against the node
tables the program made (one replay's kernels match the table name for
name, the table labels 99% of the slice's device time or more, the
optimizers' kernels by name lie in ``asv.optimizer``, ECAPA's counters
count 8 B4a and 8 B4b a replay), and the K = 8 graph with the spans'
bookkeeping against the same graph without it: the same nodes."""

import gc
import types

import pytest
import torch

from asvspoof2021_air_tpu_torch.utils import profiling
from portbench import run
from portbench.harness import bench, inputs, readers, spans, trace

TABLE = profiling.GraphTable(
    1, "train_steps", ["kernel", "memset", "kernel", "memcpy", "kernel"],
    ["void bn_fwd<float>(float*)", None, None, None, "gemm_bf16"],
    ["asv.bn", "asv.optimizer", "asv.bn:bwd", None, "asv.cast:bwd"], {})


class _Ev:
    def __init__(self, name, a, b, device):
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def _slice(device, host=(), units=2):
    """A context over a ``trace.Slice`` of made-up device and host
    events."""
    events = ([_Ev(*e, True) for e in device]
              + [_Ev(*e, False) for e in host])
    prof = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(slice=trace.Slice(prof, 0.0, units))


def _replay(t0):
    """One replay of TABLE's graph from t0 us: each node 10 us long, 1 us
    apart."""
    names = ["void bn_fwd<float>(float*)", "Memset (Device)",
             "void unnamed_kernel<2>()", "Memcpy DtoD (Device -> Device)",
             "gemm_bf16"]
    return [(n, t0 + 11 * i, t0 + 11 * i + 10) for i, n in enumerate(names)]


def test_the_split_of_a_made_up_slice(monkeypatch):
    monkeypatch.setattr(profiling, "tables", lambda: [TABLE])
    feed = [("Memcpy HtoD (Pinned -> Device)", 55, 60),
            ("Memcpy DtoD (Device -> Device)", 61, 66)]
    ctx = _slice(_replay(0) + feed + _replay(100))
    split = spans.train_split(ctx)
    assert split["replays"] == 2
    assert split["span_us"] == {"asv.bn": 20, "asv.optimizer": 20,
                                "asv.bn:bwd": 20, "asv.cast:bwd": 20}
    assert split["total_us"] == 2 * 50 + 10
    # a step is half the slice's two units' time
    assert spans.span_ms_per_unit(ctx, "asv.bn") == pytest.approx(0.02)
    assert spans.span_ms_per_unit(ctx, "asv.optimizer",
                                  backward=False) == pytest.approx(0.01)
    assert spans.span_ms_per_unit(ctx, "asv.se") is None
    assert spans.covered_pct(ctx) == pytest.approx(100 * 80 / 110)
    wrong = _replay(0)
    wrong[4] = ("gemm_fp32", 44, 54)
    ctx = _slice(wrong)
    assert spans.train_split(ctx) is None
    assert spans.span_ms_per_unit(ctx, "asv.bn") is None
    assert spans.covered_pct(ctx) is None


def test_the_scoring_readers_on_a_made_up_slice(monkeypatch):
    host = [("asv.frontend", 0, 10), ("asv.frontend.copy", 1, 6),
            ("aten::copy_", 1, 6), ("asv.trunk", 10, 20),
            ("asv.pool", 20, 22), ("asv.score_rule", 22, 23)]
    host += [(n, a + 100, b + 100) for n, a, b in host]
    # idle 1-7 (its middle in the first copy), 30-100 (in none), 101-102
    # (in the second copy)
    device = [("lfcc_kernel", 0, 1), ("gemm", 7, 30),
              ("lfcc_kernel", 100, 101), ("gemm", 102, 130)]
    ctx = _slice(device, host)
    assert spans.host_ms(ctx, ("asv.frontend.copy",)) == pytest.approx(5e-3)
    metric = lambda name: bench.load_file(
        bench.HERE / "metrics" / f"{name}.py", "test_" + name).read(ctx)
    assert metric("copy_ms_per_batch.score") == pytest.approx(5e-3)
    assert metric("dispatch_ms_per_batch.score") == pytest.approx(18e-3)
    assert metric("copy_idle_ms_per_batch.score") == pytest.approx(3.5e-3)
    monkeypatch.setattr(profiling, "counts", lambda traced=False: (
        {"h2d_bytes": 2 * 30_679_552} if traced else {}))
    assert metric("h2d_mb_per_batch.score") == pytest.approx(30.679552)
    assert spans.host_ms(_slice(device), ("asv.frontend",)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent commit's program has no tables and no counters."""
    monkeypatch.delattr(profiling, "tables")
    monkeypatch.delattr(profiling, "counts")
    ctx = _slice(_replay(0))
    assert spans.covered_pct(ctx) is None
    assert spans.traced_count_per_unit(ctx, "h2d_bytes") is None


def _traced(workload, seed, card, stub_spans=False, monkeypatch=None):
    """A cell's task set up on the card (its graph captured); with
    ``stub_spans`` every span a no-op through the capture."""
    gc.collect()
    cell = bench.Cell(workload)
    weights = inputs.make_weights(
        cell.config_module.param_spec(cell.config), seed, card)
    task = cell.task.Task(cell, seed, card, weights)
    if stub_spans:
        off = profiling._Off
        for name in ("__enter__", "__exit__"):
            monkeypatch.setattr(profiling._Span, name, getattr(off, name))
        for name in ("out", "cast"):
            monkeypatch.setattr(profiling._Span, name,
                                staticmethod(getattr(off, name)))
    task.setup()
    return cell, task


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["ecapa512-train-feat-k8",
                                      "resnet18-train-feat-k8"])
def test_the_replays_match_the_node_table(workload, card, monkeypatch):
    profiling.reset()
    cell, task = _traced(workload, 2**31 + 41, card)
    (table,) = [t for t in profiling.tables() if t.owner == "train_steps"]
    calls = cell.traffic["traced_calls"]
    sl = run.traced_slice(task, calls)
    events = sorted(sl.device, key=lambda e: e[1])
    split = spans.match(events, [table])
    assert split is not None and split["replays"] == calls
    # every kernel node named, and one replay's events those names
    assert None not in [n for k, n in zip(table.kinds, table.names)
                        if k == "kernel"]
    names = [e[0] for e in events]
    kinds = [spans.kind_of(n) for n in names]
    orders, i = [], 0
    while i < len(events):
        order = spans._match_at(kinds, names, i, table)
        if order is None:
            i += 1
            continue
        orders.append(order)
        i += len(table.kinds)
    assert len(orders) == calls
    assert [names[i] for i, k in zip(orders[0], table.kinds)
            if k == "kernel"] == [n for k, n in zip(table.kinds, table.names)
                                  if k == "kernel"]
    ctx = types.SimpleNamespace(slice=sl)
    assert spans.covered_pct(ctx) >= 99.0
    # the optimizers' kernels by name all lie in asv.optimizer, which holds
    # zero_grad's and the optimizers' other elementwise kernels besides
    in_span = sum(events[i][2] - events[i][1] for order in orders
                  for i, span in zip(order, table.spans)
                  if span == "asv.optimizer"
                  and trace.group_of(events[i][0]) == "optimizer")
    group = readers.group_ms(ctx, ("optimizer",))
    assert 1e-3 * in_span / sl.units == pytest.approx(group, rel=1e-9)
    assert spans.span_ms_per_unit(ctx, "asv.optimizer",
                                  backward=False) >= group
    traced = profiling.counts(traced=True)
    if workload.startswith("ecapa"):
        assert traced["B4a"] == traced["B4b"] == 8 * calls
    else:
        assert "B4a" not in traced
    task.release()
    torch.cuda.empty_cache()

    profiling.reset()
    _, bare = _traced(workload, 2**31 + 41, card, stub_spans=True,
                      monkeypatch=monkeypatch)
    (plain,) = [t for t in profiling.tables() if t.owner == "train_steps"]
    assert plain.kinds == table.kinds and set(plain.spans) == {None}
    assert plain.names == table.names
    bare.release()
    torch.cuda.empty_cache()
