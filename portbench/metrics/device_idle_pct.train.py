"""The device's idle share over the traced slice of training calls."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
