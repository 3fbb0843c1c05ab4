"""Device ms of cuDNN's and cuBLAS's kernels a training step."""

from portbench.harness import readers


def read(ctx):
    return readers.group_ms(ctx, ("conv", "matmul"))
