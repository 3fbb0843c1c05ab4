"""The share of the traced slice's device time whose nodes the program's graph node tables label with a span."""

from portbench.harness import spans


def read(ctx):
    return spans.covered_pct(ctx)
