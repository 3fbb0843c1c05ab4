"""Reading a profiled slice: device intervals, their union, kernel time by
name group, and the breakdown of the longest operations and idle gaps.

The groups are matched in order, first match wins, on the lower-cased
kernel name. Memory copies and sets count towards the device's busy time
but belong to no kernel group.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("B4a", ("softmax_stats_fwd_kernel",)),
    ("B4b", ("softmax_stats_bwd_",)),
    ("B1", ("lfcc_kernel",)),
    ("B2", ("res2_chain_",)),
    ("B3", ("proj_stats_", "context_bias_kernel", "attentive_pool_kernel")),
    # torch.optim's foreach and fused kernels: Adam's and SGD's steps and
    # their zero_grad
    ("optimizer", ("multi_tensor_apply", "fused_adam", "fused_sgd",
                   "adam", "sgd")),
    ("fft", ("fft",)),
    ("rnn", ("rnn", "gru", "persist")),
    # cuDNN's convolutions run implicit-GEMM kernels, matched before
    # cuBLAS's GEMMs
    ("conv", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def group_of(name: str) -> str:
    """The kernel group of ``name``; "copy" for a memory copy or set and
    "elementwise" for every other kernel."""
    if is_copy(name):
        return "copy"
    key = name.lower()
    for group, pats in KERNEL_GROUPS:
        if any(p in key for p in pats):
            return group
    return "elementwise"


def group_of_work(kernel: str) -> str:
    """The kernel group of a kernel named as ``harness/kernels.py``'s work
    names it (``B2_bf16`` is kernel B2 in bfloat16)."""
    return kernel.split("_")[0]


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def _annotation(ev) -> bool:
    """A range that annotates the device's timeline (such as
    ``Optimizer.step#Adam.step``), not device work."""
    return (bool(getattr(ev, "is_user_annotation", False))
            or ev.name.startswith(("Optimizer.", "ProfilerStep#")))


def _on_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


class Slice:
    """What one profiled slice shows: every device event (kernels, copies,
    sets) with its name, start and end in microseconds, the host's
    operations, the slice's window (CUDA events) and the units of work
    (batches or steps) it ran."""

    def __init__(self, prof, window_ms: float, units: int):
        self.units = units
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for ev in prof.events():
            tr = ev.time_range
            if _on_device(ev):
                if not _annotation(ev):
                    self.device.append((ev.name, tr.start, tr.end))
            else:
                self.host.append((ev.name, tr.start, tr.end))
        spans = [(a, b) for _, a, b in self.device]
        self.busy_us = union_us(spans)
        span = (max(b for _, b in spans) - min(a for a, _ in spans)
                if spans else 0.0)
        self.window_us = max(window_ms * 1e3, span)

    def group_us(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            g = group_of(name)
            out[g] = out.get(g, 0.0) + (b - a)
        return out

    def per_unit_s(self, groups: Sequence[str]) -> float:
        """Device seconds a unit of work in the kernels of ``groups``."""
        us = self.group_us()
        return sum(us.get(g, 0.0) for g in groups) / 1e6 / self.units

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, summed by name,
        and the ``n`` longest idle gaps inside the slice, each named by the
        innermost host operation running at its middle."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, reach = [], None
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if reach is not None and a > reach:
                gaps.append((reach, a))
            reach = b if reach is None else max(reach, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            covering = [(hb - ha, name) for name, ha, hb in self.host
                        if ha <= mid <= hb]
            label = min(covering)[1] if covering else "no host operation"
            named.append([label[:120], (b - a) / 1e6])
        return {"device_ops": [[k[:120], v / 1e6] for k, v in ops],
                "idle_gaps": named}
