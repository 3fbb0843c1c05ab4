"""Kernel B2 in bf16 (the Res2 chains of a batch): least time over device time."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, ["B2_bf16"])
