"""Kernel B1 (LFCC): its least time over its device time, a batch."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, ["B1"])
