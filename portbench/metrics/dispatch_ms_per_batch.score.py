"""Host ms a scored batch in the program's top-level spans (``asv.frontend``, ``asv.trunk``, ``asv.pool``, ``asv.score_rule`` and what they nest), less the copy in ``asv.frontend.copy``."""

from portbench.harness import spans

TOP = ("asv.frontend", "asv.trunk", "asv.pool", "asv.score_rule")


def read(ctx):
    total = spans.host_ms(ctx, TOP)
    if total is None:
        return None
    return total - (spans.host_ms(ctx, ("asv.frontend.copy",)) or 0.0)
