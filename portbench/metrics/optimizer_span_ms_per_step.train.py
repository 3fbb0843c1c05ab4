"""Device ms a training step in the K-step graph's nodes that the program's span ``asv.optimizer`` made (zero_grad and every optimizer's step)."""

from portbench.harness import spans


def read(ctx):
    return spans.span_ms_per_unit(ctx, "asv.optimizer", backward=False)
