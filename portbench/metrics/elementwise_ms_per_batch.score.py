"""Device ms of the kernels outside the named groups (PyTorch's elementwise, reduction, BN, cast and copy kernels) a scored batch."""

from portbench.harness import readers


def read(ctx):
    return readers.group_ms(ctx, ("elementwise",))
