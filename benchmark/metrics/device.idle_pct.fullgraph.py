"""As device.idle_pct.sampled, in whole-graph cells."""

from benchmark.readings import idle_pct


def read(ctx):
    return idle_pct(ctx, "fullgraph")
