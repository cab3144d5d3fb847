"""K1 (`ops/cuda/gather_agg`: the forward, dx and dx's transpose): the
bytes-once bound of each step's launches at their padded shapes and
counted edges, over the device time of those kernels.  Two forward
launches a step (one a layer) are what the bound assumes."""

from benchmark.readings import roofline_pct


def read(ctx):
    layers = len(ctx.kernel_layers)
    return roofline_pct(ctx, "gather_agg", "sampled", "gather_agg_fwd",
                        layers)
