"""K4's two passes B1 and B2 (`ops/cuda/gat_bwd`): the bytes-once bound
of an epoch's launches over their device time."""

from benchmark.readings import roofline_pct


def read(ctx):
    layers = len(ctx.kernel_layers)
    return roofline_pct(ctx, "gat_bwd", "fullgraph", "gat_bwd_dst_", layers)
