"""Required forward and backward FLOPs of the traced steps at their valid
shapes (benchmark/bounds.py), over the traced window, against the card's
product peak for the configuration's dtype."""

from benchmark.readings import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "sampled")
