"""Device idle ms a scored batch in the gaps whose middle falls inside the program's span ``asv.frontend.copy``."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms_under(ctx, "asv.frontend.copy")
