"""Kernels B4a and B4b together: the sum of their least times over the sum of their device times, a step."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, ["B4a", "B4b"])
