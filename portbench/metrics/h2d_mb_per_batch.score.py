"""MB a scored batch copied from the host to the card: the change of the program's counter ``h2d_bytes`` over the traced slice, over its batches, / 1e6."""

from portbench.harness import spans


def read(ctx):
    n = spans.traced_count_per_unit(ctx, "h2d_bytes")
    return None if n is None else n / 1e6
