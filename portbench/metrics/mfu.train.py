"""Model FLOPs (3 x the forward) of the utterances trained in the untraced window, over its seconds and the bf16 peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx)
