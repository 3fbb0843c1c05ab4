"""Kernel B3 (serving attention pooling): least time over device time, a batch."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, ["B3"])
