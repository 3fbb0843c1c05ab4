"""Device ms a training step in the K-step graph's nodes that the program's span ``asv.bn`` or ``asv.bn:bwd`` made (the graph's node table matched against the replays' kernels)."""

from portbench.harness import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "asv.bn")
