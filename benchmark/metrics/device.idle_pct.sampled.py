"""Share of the traced window in which nothing ran on the card: 1 - the
union of kernel, copy and memset intervals over the window."""

from benchmark.readings import idle_pct


def read(ctx):
    return idle_pct(ctx, "sampled")
