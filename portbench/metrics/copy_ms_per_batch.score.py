"""Host ms a scored batch in the program's span ``asv.frontend.copy`` (the waveforms' and lengths' copy to the card)."""

from portbench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("asv.frontend.copy",))
