"""Device ms of the optimizers' kernels (Adam's and SGD's foreach and fused kernels, their zero_grad) a training step."""

from portbench.harness import readers


def read(ctx):
    return readers.group_ms(ctx, ("optimizer",))
