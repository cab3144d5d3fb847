"""K3 (`ops/cuda/gat`, in the training and the METRICS clean forward):
the bytes-once bound of an epoch's launches over their device time."""

from benchmark.readings import forwards_per_epoch, roofline_pct


def read(ctx):
    layers = len(ctx.kernel_layers)
    return roofline_pct(ctx, "gat", "fullgraph", "gat_kernel<",
                        forwards_per_epoch(ctx.cell) * layers)
