"""What the per-layer metrics' readers share. Each reader takes the traced
run's context: ``slice`` (``harness/trace.Slice``), ``window`` (the
untraced window's work and seconds), ``flops`` (the window's model FLOPs),
``work`` (each hand-written kernel's operations, bytes and peak a unit of
work, from ``harness/kernels.py``) and ``peak`` (the configuration's
compute peak). A reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.harness import kernels, trace


def idle_pct(ctx) -> Optional[float]:
    """100 minus the union of the device's intervals over the slice's
    window."""
    return ctx.slice.idle_pct() if ctx.slice.device else None


def mfu(ctx) -> Optional[float]:
    """The window's model FLOPs over its seconds and the compute peak."""
    if not ctx.window["seconds"] or not ctx.flops:
        return None
    return 100.0 * ctx.flops / ctx.window["seconds"] / ctx.peak


def group_ms(ctx, groups: Sequence[str]) -> Optional[float]:
    """Device ms a unit of work in the kernels of ``groups``."""
    s = ctx.slice.per_unit_s(groups)
    return 1e3 * s if s > 0 else None


def roofline_pct(ctx, names: Sequence[str]) -> Optional[float]:
    """The least time of the kernels ``names`` over their measured device
    time, a unit of work; None where the cell runs none of them."""
    if not all(n in ctx.work for n in names):
        return None
    measured = ctx.slice.per_unit_s([trace.group_of_work(n) for n in names])
    if measured <= 0:
        return None
    least = sum(kernels.least_seconds(ctx.work[n]) for n in names)
    return 100.0 * least / measured
