"""As step.mfu_pct.sampled, per whole-graph epoch (the METRICS clean
forward is not counted)."""

from benchmark.readings import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "fullgraph")
